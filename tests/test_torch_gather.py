"""The port's narrow-phase gather (K2) and scatter-add (K3) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_gather_pallas.py runs them.  On a CPU tensor the port's
wrappers take their plain versions; the kernels themselves are held to
those on the card (tests/test_torch_cuda.py, chip_smoke.py).  The row plan
K3 reads is held to numpy's stable argsort, and a plain sum that reads it
as K3 does to the Pallas kernel."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.ops.gather_pallas import gather_rows as j_gather
from smplifyx_tpu.ops.gather_pallas import scatter_add_rows as j_scatter

from smplifyx_torch.ops import gather as tg


def inputs(B, N, R, C, seed, id_rows=None):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(B, N, C)).astype(np.float32)
    ids = rng.integers(0, id_rows or N, size=(B, R)).astype(np.int32)
    values = rng.normal(size=(B, R, C)).astype(np.float32)
    return table, ids, values


def jax_batched(fn, *args):
    return np.asarray(jax.vmap(fn)(*[jnp.asarray(a) for a in args]))


@pytest.mark.parametrize("B,N,R,C", [
    (1, 1000, 4096, 3),     # one lane, aligned
    (3, 777, 1001, 3),      # N not a multiple of 64, R odd
    (2, 555, 2048, 9),      # the width-9 corner rows
    (3, 129, 333, 9),       # width 9, ragged
])
def test_gather_plain_version_equals_pallas_bit_for_bit(B, N, R, C):
    table, ids, _ = inputs(B, N, R, C, seed=N + R)
    want = jax_batched(lambda t, i: j_gather(t, i, interpret=True), table, ids)
    before = tg.gather_rows.launches
    got = tg.gather_rows(torch.as_tensor(table),
                         torch.as_tensor(ids.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tg.gather_rows.launches == before   # CPU tensors launch nothing


@pytest.mark.parametrize("B,N,R,C,id_rows,tol", [
    (1, 1000, 4096, 3, None, 1e-6),
    (3, 777, 1001, 3, None, 1e-6),
    (2, 555, 2048, 9, None, 1e-6),
    (2, 100, 3000, 3, 5, 1e-5),     # duplicate-heavy: all ids in 5 rows
    (2, 64, 3000, 9, 5, 1e-5),
])
def test_scatter_plain_version_matches_pallas(B, N, R, C, id_rows, tol):
    _, ids, values = inputs(B, N, R, C, seed=N + R, id_rows=id_rows)
    want = jax_batched(lambda i, v: j_scatter(i, v, N, interpret=True),
                       ids, values)
    before = tg.scatter_add_rows.launches
    got = tg.scatter_add_rows(torch.as_tensor(ids.astype(np.int64)),
                              torch.as_tensor(values), N)
    assert got.shape == (B, N, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    assert tg.scatter_add_rows.launches == before


def test_scatter_is_the_gather_vjp():
    table, ids, values = inputs(2, 50, 300, 3, seed=4)
    t = torch.as_tensor(table).requires_grad_(True)
    i = torch.as_tensor(ids.astype(np.int64))
    g = torch.as_tensor(values)
    (tg.gather_reference(t, i) * g).sum().backward()
    np.testing.assert_allclose(tg.scatter_add_rows(i, g, 50).numpy(),
                               t.grad.numpy(), rtol=1e-6, atol=1e-6)


def test_wrappers_check_their_inputs():
    table = torch.zeros(2, 10, 3)
    ids = torch.zeros(2, 4, dtype=torch.int64)
    with pytest.raises(TypeError, match="int32 or int64"):
        tg.gather_rows(table, ids.short())
    with pytest.raises(TypeError, match="float32"):
        tg.gather_rows(table.double(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        tg.gather_rows(table.transpose(0, 1).contiguous().transpose(0, 1), ids)
    with pytest.raises(ValueError, match="B=2"):
        tg.gather_rows(table, ids[:1])
    with pytest.raises(ValueError, match="4 ids for 5 rows"):
        tg.scatter_add_rows(ids, torch.zeros(2, 5, 3), 10)
    with pytest.raises(IndexError):
        tg.gather_rows(table, ids + 10)    # out of range on the CPU raises


def test_cpu_tensors_never_touch_the_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the kernel loader ran for CPU tensors")

    monkeypatch.setattr(tg, "_load", refuse)
    monkeypatch.setattr(tg.nvcc, "build", refuse)
    monkeypatch.setattr(tg.nvcc, "load", refuse)
    table, ids, values = inputs(2, 30, 40, 9, seed=5)
    i = torch.as_tensor(ids.astype(np.int64))
    tg.gather_rows(torch.as_tensor(table), i)
    tg.scatter_add_rows(i, torch.as_tensor(values), 30)


def padding_heavy(B, N, R, C, seed, share=0.95):
    """Inputs whose ids put ~share of each lane on row 0, as the pair
    list's padding slots do at level 2."""
    table, ids, values = inputs(B, N, R, C, seed)
    rng = np.random.default_rng(seed + 1)
    ids[rng.random((B, R)) < share] = 0
    return table, ids, values


def planned_sum(plan, values, num_rows):
    """A plain sum that reads the plan as K3 does: each lane's values in
    the plan's order, summed over the runs of equal sorted ids (ids
    outside [0, num_rows) dropped)."""
    plan, values = np.asarray(plan), np.asarray(values)
    B, _, R = plan.shape
    out = np.zeros((B, num_rows, values.shape[2]), np.float32)
    for b in range(B):
        order, keys = plan[b, 1], plan[b, 2]
        starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
        sums = np.add.reduceat(values[b][order], starts, axis=0)
        run_keys = keys[starts]
        keep = (run_keys >= 0) & (run_keys < num_rows)
        out[b, run_keys[keep]] = sums[keep]
    return out


@pytest.mark.parametrize("B,N,R,C,kind,dtype", [
    (2, 50, 300, 3, "uniform", np.int64),
    (3, 20, 1001, 9, "uniform", np.int32),
    (2, 64, 3000, 3, "padding", np.int64),
    (2, 30, 65, 4, "sentinels", np.int64),
])
def test_row_plan_equals_numpy_argsort_and_searchsorted(B, N, R, C, kind, dtype):
    if kind == "padding":
        _, ids, _ = padding_heavy(B, N, R, C, seed=R)
    else:
        _, ids, _ = inputs(B, N, R, C, seed=R)
    ids = ids.astype(dtype)
    if kind == "sentinels":
        ids[:, ::7] = -3
        ids[:, 1::7] = 2 ** 40         # beyond int32: kept out of range
    before = tg.row_plan.builds
    plan = tg.row_plan(torch.as_tensor(ids)).numpy()
    assert tg.row_plan.builds == before + 1
    assert plan.dtype == np.int32 and plan.shape == (B, 3, R)
    want = np.where((ids >= 0) & (ids < 2 ** 31), ids, -1).astype(np.int32)
    np.testing.assert_array_equal(plan[:, 0], want)
    order = np.argsort(want, axis=1, kind="stable")
    np.testing.assert_array_equal(plan[:, 1], order)
    np.testing.assert_array_equal(plan[:, 2], np.take_along_axis(want, order, 1))
    for b in range(B):
        keys = plan[b, 2]
        runs = np.unique(keys)
        starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
        ends = np.r_[starts[1:], R]
        np.testing.assert_array_equal(np.searchsorted(keys, runs, "left"), starts)
        np.testing.assert_array_equal(np.searchsorted(keys, runs, "right"), ends)


@pytest.mark.parametrize("B,N,R,C,id_rows,tol", [
    (1, 1000, 4096, 3, None, 1e-6),
    (3, 777, 1001, 3, None, 1e-6),
    (2, 555, 2048, 9, None, 1e-6),
    (2, 100, 3000, 3, 5, 1e-5),     # duplicate-heavy: all ids in 5 rows
    (2, 64, 3000, 9, 5, 1e-5),
    (2, 256, 4096, 9, "padding", 1e-5),   # ~95% of ids on row 0
])
def test_planned_sum_matches_pallas(B, N, R, C, id_rows, tol):
    if id_rows == "padding":
        _, ids, values = padding_heavy(B, N, R, C, seed=N + R)
    else:
        _, ids, values = inputs(B, N, R, C, seed=N + R, id_rows=id_rows)
    want = jax_batched(lambda i, v: j_scatter(i, v, N, interpret=True),
                       ids, values)
    plan = tg.row_plan(torch.as_tensor(ids))
    np.testing.assert_allclose(planned_sum(plan, values, N), want,
                               rtol=tol, atol=tol)


def test_scatter_with_a_plan_equals_without():
    _, ids, values = padding_heavy(2, 40, 500, 9, seed=8)
    for i in (torch.as_tensor(ids.astype(np.int64)), torch.as_tensor(ids)):
        v = torch.as_tensor(values)
        plan = tg.row_plan(i)
        got = tg.scatter_add_rows(plan, v, 40)
        assert torch.equal(got, tg.scatter_add_rows(i, v, 40))
    with pytest.raises(ValueError, match="plan"):
        tg.scatter_add_rows(plan[:, :2].contiguous(), v, 40)
    with pytest.raises(ValueError, match="plan"):
        tg.scatter_add_rows(plan.long(), v, 40)
    with pytest.raises(ValueError, match="plan"):
        tg.scatter_add_rows(plan[:, :, :-1].contiguous(), v, 40)


@pytest.mark.parametrize("B,N,R,C", [(3, 777, 1001, 3), (2, 555, 2048, 9),
                                     (2, 40, 300, 5)])
def test_gather_int32_ids_equal_int64_bit_for_bit(B, N, R, C):
    table, ids, _ = inputs(B, N, R, C, seed=R)
    t = torch.as_tensor(table)
    want = tg.gather_rows(t, torch.as_tensor(ids.astype(np.int64)))
    plan = tg.row_plan(torch.as_tensor(ids))
    assert torch.equal(tg.gather_rows(t, torch.as_tensor(ids)), want)
    assert torch.equal(tg.gather_rows(t, plan[:, 0]), want)   # a strided view

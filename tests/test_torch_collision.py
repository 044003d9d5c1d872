"""The port's collision term against the JAX package's, on the CPU.

The broad phase is comparisons, compactions and IEEE arithmetic, so on the
same vertices every array it returns (Morton order, candidate pairs,
per-level survivor counts, the aux of build and build_refresh) equals
JAX's exactly.  The penalty and its gradient agree to f32 summation
order.  Meshes: the small posed-human proxy with its part segmentation and
an ignored part pair, and the V=96 synthetic model with
`synthetic_part_segm`; two lanes each, the second perturbed."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.models.bodymodel import synthetic_model as j_synthetic_model
from smplifyx_tpu.models.forward import BodyParams as JBodyParams
from smplifyx_tpu.models.forward import smplx_forward as j_forward
from smplifyx_tpu.ops import collision as jc
from smplifyx_tpu.utils.proxy_mesh import build_posed_human, oracle_overlap_pairs

from smplifyx_torch import convert
from smplifyx_torch.fitting.lbfgs import _pick_aux
from smplifyx_torch.ops import collision as tc
from smplifyx_torch.ops.gather import row_plan

AUX_FIELDS = ("tri_corners", "pa", "pb", "valid", "order", "sorted_pack")


def _proxy():
    verts, faces, segm, parents = build_posed_human(scale_faces=0.2)
    noise = np.random.default_rng(0).normal(0, 2e-3, verts.shape)
    V = np.stack([verts, verts + noise.astype(np.float32)])
    return V, faces, segm, parents, dict(ign_part_pairs=["1,4"], sigma=0.01)


def _synthetic():
    model = j_synthetic_model(num_verts=96, seed=0)
    rng = np.random.default_rng(1)
    params = JBodyParams.zeros(2).replace(body_pose=jnp.asarray(
        rng.normal(0, 0.2, (2, 63)), jnp.float32))
    V = np.asarray(j_forward(model, params).vertices)
    faces = np.asarray(model.faces)
    segm, parents = jc.synthetic_part_segm(faces.shape[0], seed=1)
    return V, faces, segm, parents, dict(sigma=1e-3)


MESHES = {"proxy": _proxy, "synthetic96": _synthetic}


@pytest.fixture(scope="module", params=sorted(MESHES))
def mesh(request):
    V, faces, segm, parents, kw = MESHES[request.param]()
    jfn = jc.make_collision_fn(jnp.asarray(faces), segm=segm, parents=parents,
                               **kw)
    tfn = tc.make_collision_fn(torch.as_tensor(faces.astype(np.int64)),
                               segm=segm, parents=parents, **kw)
    jaux = jax.jit(jax.vmap(jfn.build))(jnp.asarray(V))
    return dict(V=V, jfn=jfn, tfn=tfn, jaux=jaux, tV=torch.as_tensor(np.array(V)),
                kw=kw, faces=faces, segm=segm, parents=parents)


def _np_aux(jaux):
    tri_corners, (pa, pb), valid, order, sorted_pack = jaux
    return dict(tri_corners=tri_corners, pa=pa, pb=pb, valid=valid,
                order=order, sorted_pack=sorted_pack)


def _assert_aux_equal(got, want):
    want = _np_aux(want)
    for name in AUX_FIELDS:
        w = np.asarray(want[name])
        w = w.astype(bool) if name == "valid" else w.astype(np.int64)
        np.testing.assert_array_equal(getattr(got, name).numpy(), w,
                                      err_msg=name)


def test_interleave_matches_jax():
    x = np.arange(1024, dtype=np.uint32)
    want = np.asarray(jc._interleave3(jnp.asarray(x)))
    got = tc._interleave3(torch.as_tensor(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_compact_matches_jax():
    flat = np.random.default_rng(2).random((3, 500)) < 0.1
    for size in (7, 60):
        jpos, jvalid = jax.vmap(lambda f: jc._compact(f, size))(jnp.asarray(flat))
        pos, valid = tc._compact(torch.as_tensor(flat), size)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_morton_order_equals_jax(mesh):
    want = jax.vmap(mesh["jfn"].morton_order)(jnp.asarray(mesh["V"]))
    np.testing.assert_array_equal(mesh["tfn"].morton_order(mesh["tV"]).numpy(),
                                  np.asarray(want))


def test_candidate_pairs_equal_jax(mesh):
    ja, jb, jv = jax.vmap(mesh["jfn"].candidate_pairs)(jnp.asarray(mesh["V"]))
    ta, tb, tv = mesh["tfn"].candidate_pairs(mesh["tV"])
    assert int(tv.sum()) > 0
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_saturation_equals_jax(mesh):
    want = jax.vmap(lambda v: {k: c for k, (c, _) in
                               mesh["jfn"].saturation(v).items()})(
        jnp.asarray(mesh["V"]))
    got = mesh["tfn"].saturation(mesh["tV"])
    assert set(got) == set(want)
    budgets = {k: b for k, (_, b) in
               mesh["jfn"].saturation(jnp.asarray(mesh["V"][0])).items()}
    for level, (count, budget) in got.items():
        np.testing.assert_array_equal(count.numpy(), np.asarray(want[level]),
                                      err_msg=level)
        assert budget == budgets[level], level


def test_build_equals_jax(mesh):
    _assert_aux_equal(mesh["tfn"].build(mesh["tV"]), mesh["jaux"])


def test_build_refresh_equals_jax(mesh):
    moved = mesh["V"] + np.random.default_rng(3).normal(
        0, 5e-3, mesh["V"].shape).astype(np.float32)
    want = jax.vmap(mesh["jfn"].build_refresh)(jnp.asarray(moved), mesh["jaux"])
    got = mesh["tfn"].build_refresh(torch.as_tensor(moved),
                                    convert.collision_aux(mesh["jaux"], "cpu"))
    _assert_aux_equal(got, want)


@pytest.mark.parametrize("penalize_outside,point2plane", [
    (True, False), (False, False), (True, True), (False, True)])
def test_apply_value_and_gradient_match_jax(mesh, penalize_outside, point2plane):
    kw = dict(mesh["kw"], penalize_outside=penalize_outside,
              point2plane=point2plane)
    jfn = jc.make_collision_fn(jnp.asarray(mesh["faces"]), segm=mesh["segm"],
                               parents=mesh["parents"], **kw)
    tfn = tc.make_collision_fn(torch.as_tensor(mesh["faces"].astype(np.int64)),
                               segm=mesh["segm"], parents=mesh["parents"], **kw)
    # Evaluate away from the build pose, as a line-search trial does.
    V = mesh["V"] + np.random.default_rng(4).normal(
        0, 1e-3, mesh["V"].shape).astype(np.float32)

    def jval(v, aux):
        return jfn.apply(v, aux)

    jv, jg = jax.vmap(jax.value_and_grad(jval))(jnp.asarray(V), mesh["jaux"])
    tV = torch.as_tensor(V).requires_grad_(True)
    tv = tfn.apply(tV, convert.collision_aux(mesh["jaux"], "cpu"))
    (tg,) = torch.autograd.grad(tv.sum(), tV)
    jv, jg = np.asarray(jv), np.asarray(jg)
    assert (jv > 0).all()
    np.testing.assert_allclose(tv.detach().numpy(), jv, rtol=1e-5)
    scale = max(1.0, np.abs(jg).max())
    assert np.abs(tg.numpy() - jg).max() <= 1e-5 * scale


def test_penalty_equals_jax_exact_path(mesh):
    want = jax.vmap(mesh["jfn"])(jnp.asarray(mesh["V"]))
    got = mesh["tfn"](mesh["tV"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_pair_gather_kernel_wrappers_equal_plain_version(mesh):
    aux = mesh["tfn"].build(mesh["tV"])
    args = (aux.tri_corners, aux.pa, aux.pb)
    V1 = mesh["tV"].clone().requires_grad_(True)
    V2 = mesh["tV"].clone().requires_grad_(True)
    ta, tb = tc.pair_gather(V1, *args)
    ra, rb = tc.pair_gather_reference(V2, *args)
    assert torch.equal(ta, ra) and torch.equal(tb, rb)
    g = torch.randn(ta.shape, generator=torch.Generator().manual_seed(0))
    ((ta + 2 * tb) * g).sum().backward()
    ((ra + 2 * rb) * g).sum().backward()
    # two scatter levels sum in another order than one index backward
    scale = max(1.0, V2.grad.abs().max().item())
    assert (V1.grad - V2.grad).abs().max().item() <= 1e-5 * scale


def _assert_plans_of_ids(aux):
    B, T, _ = aux.tri_corners.shape
    assert torch.equal(aux.corner_plan, row_plan(aux.tri_corners.reshape(B, 3 * T)))
    assert torch.equal(aux.pair_plan, row_plan(torch.cat([aux.pa, aux.pb], 1)))


def test_aux_carries_the_row_plans_of_its_ids(mesh):
    aux = mesh["tfn"].build(mesh["tV"])
    _assert_plans_of_ids(aux)
    converted = convert.collision_aux(mesh["jaux"], "cpu")
    _assert_plans_of_ids(converted)
    assert torch.equal(converted.pair_plan, aux.pair_plan)
    assert torch.equal(converted.corner_plan, aux.corner_plan)


def test_pick_aux_merges_plans_lane_by_lane(mesh):
    """The L-BFGS loop refreshes some lanes' aux and keeps the others'
    (`_pick_aux`): the merged plans are the plans of the merged ids."""
    old = mesh["tfn"].build(mesh["tV"])
    moved = mesh["V"] + np.random.default_rng(5).normal(
        0, 2e-2, mesh["V"].shape).astype(np.float32)
    new = mesh["tfn"].build_refresh(torch.as_tensor(moved), old)
    assert not torch.equal(new.pair_plan, old.pair_plan)
    for pick in ([True, False], [False, True]):
        merged = _pick_aux(torch.tensor(pick), new, old)
        assert isinstance(merged, tc.CollisionAux)
        _assert_plans_of_ids(merged)
        for lane, fresh in enumerate(pick):
            want = new if fresh else old
            assert torch.equal(merged.pair_plan[lane], want.pair_plan[lane])


def test_pair_gather_on_the_aux_plans_equals_plain_version(mesh):
    aux = mesh["tfn"].build(mesh["tV"])
    V1 = mesh["tV"].clone().requires_grad_(True)
    V2 = mesh["tV"].clone().requires_grad_(True)
    ta, tb = tc._PairGather.apply(V1, aux.corner_plan, aux.pair_plan)
    ra, rb = tc.pair_gather_reference(V2, aux.tri_corners, aux.pa, aux.pb)
    assert torch.equal(ta, ra) and torch.equal(tb, rb)
    g = torch.randn(ta.shape, generator=torch.Generator().manual_seed(1))
    ((ta - 3 * tb) * g).sum().backward()
    ((ra - 3 * rb) * g).sum().backward()
    # two scatter levels sum in another order than one index backward
    scale = max(1.0, V2.grad.abs().max().item())
    assert (V1.grad - V2.grad).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("ign", [[], ["1,4"]])
def test_candidate_pairs_equal_the_exact_oracle(ign):
    """Mirror of tests/test_collision_oracle.py::TestOracleSmall: on the
    small proxy mesh the broad phase finds exactly the AABB-overlapping,
    part-filtered pairs of an O(F^2) numpy oracle."""
    verts, faces, segm, parents = build_posed_human(scale_faces=0.2)
    pairs = [tuple(int(v) for v in e.split(",")) for e in ign]
    oi, oj = oracle_overlap_pairs(verts, faces, segm, parents, ign_pairs=pairs)
    assert len(oi) > 50
    fn = tc.make_collision_fn(torch.as_tensor(faces.astype(np.int64)),
                              segm=segm, parents=parents, ign_part_pairs=ign)
    ia, ib, valid = fn.candidate_pairs(torch.as_tensor(verts)[None])
    ia, ib = ia[0][valid[0]].numpy(), ib[0][valid[0]].numpy()
    found = set(zip(np.minimum(ia, ib).tolist(), np.maximum(ia, ib).tolist()))
    oracle = set(zip(np.minimum(oi, oj).tolist(), np.maximum(oi, oj).tolist()))
    assert found == oracle

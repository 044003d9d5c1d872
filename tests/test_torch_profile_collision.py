"""tools/profile_collision.py on the CPU at a tiny size: every component,
broad-phase step and narrow-phase part is printed, on the host clock (no
device metric from a CPU run), and each step the tool times alone gives
the very intermediate that `CollisionFn.build` computes.  The tool runs
at the slice's full width; here `tool.video_problem` is swapped for one
that builds the same problem at V vertices."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from smplifyx_torch.ops.collision import CollisionFn
from smplifyx_torch.problem import video_problem
from smplifyx_torch.tools import profile_collision as tool
from smplifyx_torch.utils.timing import kernel_name

B, V = 2, 500
LEVELS = {"superblock", "hit_superblock", "hit", "final", "narrow_tris"}


def small(num_verts, max_iters=None):
    """`video_problem` at num_verts vertices, whatever width the tool asks
    for; with max_iters, L-BFGS cut to that many body iterations."""
    def make(batch, _width, kind, device):
        p = video_problem(batch, num_verts, kind, device)
        if max_iters is None:
            return p
        lbfgs = dataclasses.replace(p.options.lbfgs, max_iters=max_iters)
        return dataclasses.replace(p, options=dataclasses.replace(
            p.options, lbfgs=lbfgs))
    return make


@pytest.fixture(scope="module")
def printed():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tool, "video_problem", small(V))
        return tool.main([str(B), "--stages", "--apply", "--platform", "cpu"])


def test_prints_every_component_on_the_host_clock(printed, capsys):
    row = printed
    assert row["clock"] == "host" and row["card"] == "cpu"
    assert not any(k.startswith("device") or "_device_" in k for k in row)
    for key, names in (("host_ms", tool.COMPONENTS),
                       ("stages_host_ms", CollisionFn.BUILD_STEPS),
                       ("apply_host_ms", tool.APPLY_PARTS)):
        assert list(row[key]) == list(names), key
        assert all(np.isfinite(v) and v > 0 for v in row[key].values()), key
    assert set(row["saturation"]) == LEVELS
    for level in row["saturation"].values():
        assert 0 < level["max"] <= level["budget"]
    assert (row["B"], row["V"]) == (B, V)


def test_the_json_line_is_printed(monkeypatch, capsys):
    monkeypatch.setattr(tool, "video_problem", small(96))
    tool.main([str(B), "--platform", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    row = json.loads(lines[-1])
    assert row["tool"] == "profile_collision"
    assert list(row["host_ms"]) == list(tool.COMPONENTS)
    assert "stages_host_ms" not in row and "apply_host_ms" not in row


@pytest.fixture(scope="module")
def steps():
    """The tool's step outputs, and the intermediates of the collision
    term's own build on the same vertices (each `_step_<name>`'s return
    recorded while `build` runs)."""
    p = video_problem(B, V, "slice", "cpu")
    fn = p.collision_fn
    verts = p.gt_vertices
    _, ours = tool.stage_outputs(fn, verts)
    seen = {}
    for name in fn.BUILD_STEPS:
        method = getattr(fn, "_step_" + name)

        def recorded(st, _method=method, _name=name):
            seen[_name] = _method(st)
            return seen[_name]

        setattr(fn, "_step_" + name, recorded)
    aux = fn.build(verts)
    for name in fn.BUILD_STEPS:
        delattr(fn, "_step_" + name)
    return ours, seen, aux


def _equal(a, b):
    if a is None or b is None:
        return a is b
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("name", CollisionFn.BUILD_STEPS)
def test_each_step_equals_the_builds_intermediate(steps, name):
    ours, seen, _ = steps
    assert set(ours[name]) == set(seen[name])
    for key in seen[name]:
        assert _equal(ours[name][key], seen[name][key]), (name, key)


def test_the_last_step_is_the_builds_aux(steps):
    ours, _, aux = steps
    assert all(_equal(a, b) for a, b in zip(ours["row_plans"]["aux"], aux))
    assert int(aux.valid.sum()) > 0


def test_trace_sums_time_per_op_name(monkeypatch):
    """The traced collision stage cut to 2 L-BFGS iterations here."""
    monkeypatch.setattr(tool, "video_problem", small(96, max_iters=2))
    row = tool.main(["2", "--trace", "--platform", "cpu"])
    for region in ("build", "egrad", "stage"):
        got = row["trace"][region]
        assert got["busy_host_ms"] > 0 and got["top"]
        assert all(e["host_ms"] >= 0 and e["count"] > 0 for e in got["top"])
    assert row["trace"]["stage"]["evals"]["max"] > 0


_MUL = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
        "impl_nocast<at::native::BinaryFunctor<float, float, float, at::native"
        "::binary_internal::MulFunctor<float> > >(at::TensorIteratorBase&, at"
        "::native::BinaryFunctor<float, float, float, at::native::binary_"
        "internal::MulFunctor<float> > const&)::{lambda(int)#1}>(int, at::"
        "native::gpu_kernel_impl_nocast<at::native::BinaryFunctor<float, "
        "float, float, at::native::binary_internal::MulFunctor<float> > >(at"
        "::TensorIteratorBase&, at::native::BinaryFunctor<float, float, float"
        ", at::native::binary_internal::MulFunctor<float> > const&)::{lambda"
        "(int)#1})")


@pytest.mark.parametrize("key, want", [
    (_MUL, _MUL[5:_MUL.rindex("(int, at::")]),
    ("void k3_join(float const*, int const*, float*, int)", "k3_join"),
    ("lbs_kernel", "lbs_kernel"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH (Device -> Pageable)"),
])
def test_kernel_names_keep_their_template_arguments(key, want):
    """The trace's kernel names drop `void` and the parameter list only:
    two elementwise kernels differ in their functor, which stays."""
    assert kernel_name(key) == want
    add = _MUL.replace("MulFunctor", "AddFunctor")
    assert kernel_name(add) != kernel_name(_MUL)

"""Exact-oracle audit of the port's collision broad phase, on the CPU.

The port's own `utils/proxy_mesh.py` must build the JAX package's arrays;
the port's `CollisionFn` (ops/collision.py) must then find exactly the
AABB-overlapping pairs that survive part filtering, as
tests/test_collision_oracle.py asks of the JAX package: on the ~3.4k-face
proxy (TestOracleSmall) and on the ~21k-face one at the defaults of
`make_collision_fn`, with >= 2x headroom at every budget."""

import numpy as np
import pytest
import torch

from smplifyx_tpu.utils import proxy_mesh as jproxy

from smplifyx_torch.ops.collision import make_collision_fn
from smplifyx_torch.utils.proxy_mesh import (
    build_posed_human,
    oracle_overlap_pairs,
    uv_ellipsoid,
)

from tests.test_collision_oracle import segm_offsets


def pair_set(idx_a, idx_b, valid=None):
    if valid is not None:
        idx_a, idx_b = idx_a[valid], idx_b[valid]
    lo = np.minimum(idx_a, idx_b)
    hi = np.maximum(idx_a, idx_b)
    return set(zip(lo.tolist(), hi.tolist()))


def found_pairs(fn, verts):
    ia, ib, valid = fn.candidate_pairs(torch.as_tensor(verts)[None])
    return pair_set(ia[0].numpy(), ib[0].numpy(), valid[0].numpy())


@pytest.fixture(scope="module")
def small():
    return build_posed_human(scale_faces=0.2)


@pytest.fixture(scope="module")
def full():
    return build_posed_human(scale_faces=1.25)


@pytest.mark.parametrize("scale", [0.2, 1.25])
def test_proxy_mesh_equals_jax(scale):
    for got, ref in zip(build_posed_human(scale),
                        jproxy.build_posed_human(scale)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    rot = np.eye(3)[[1, 0, 2]]
    for got, ref in zip(uv_ellipsoid([0, 1, 0], [1, 2, 3], 9, 7, rot),
                        jproxy.uv_ellipsoid([0, 1, 0], [1, 2, 3], 9, 7, rot)):
        np.testing.assert_array_equal(got, ref)


def test_oracle_equals_jax(small):
    verts, faces, segm, parents = small
    for ign in ((), [(1, 4)]):
        got = oracle_overlap_pairs(verts, faces, segm, parents, ign_pairs=ign)
        ref = jproxy.oracle_overlap_pairs(verts, faces, segm, parents,
                                          ign_pairs=ign)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


class TestOracleSmall:
    def test_broad_phase_equals_oracle(self, small):
        verts, faces, segm, parents = small
        oi, oj = oracle_overlap_pairs(verts, faces, segm, parents)
        assert len(oi) > 50, "proxy mesh lost its self-contacts"
        fn = make_collision_fn(torch.as_tensor(faces), segm=segm,
                               parents=parents, max_pairs=4096)
        found, oracle = found_pairs(fn, verts), pair_set(oi, oj)
        assert not oracle - found, f"lost {len(oracle - found)} real pairs"
        assert not found - oracle, f"invented {len(found - oracle)} pairs"

    def test_ignore_pairs_respected(self, small):
        verts, faces, segm, parents = small
        # forearm(4)-torso(1) contacts exist; ignoring the pair removes them
        oi, oj = oracle_overlap_pairs(verts, faces, segm, parents,
                                      ign_pairs=[(1, 4)])
        assert not any({segm[a], segm[b]} == {1, 4} for a, b in zip(oi, oj))
        fn = make_collision_fn(torch.as_tensor(faces), segm=segm,
                               parents=parents, ign_part_pairs=["1,4"],
                               max_pairs=4096)
        assert found_pairs(fn, verts) == pair_set(oi, oj)

    def test_penalty_positive_on_contacts_zero_when_separated(self, small):
        verts, faces, segm, parents = small
        fn = make_collision_fn(torch.as_tensor(faces), segm=segm,
                               parents=parents, max_pairs=4096, sigma=0.01,
                               penalize_outside=False)
        assert float(fn(torch.as_tensor(verts)[None])[0]) > 0.0
        # Explode the parts apart: nothing collides.
        exploded = verts + segm_offsets(verts, faces, segm)
        assert float(fn(torch.as_tensor(exploded)[None])[0]) == 0.0


class TestOracleFullScale:
    """The reference's scale: F ~= 21k faces, > 1,000 real contacts, at
    the defaults of make_collision_fn."""

    def test_defaults_are_lossless(self, full):
        verts, faces, segm, parents = full
        assert 19000 < len(faces) < 23000
        oi, oj = oracle_overlap_pairs(verts, faces, segm, parents)
        assert len(oi) > 1000          # heavy self-contact
        fn = make_collision_fn(torch.as_tensor(faces), segm=segm,
                               parents=parents)
        found, oracle = found_pairs(fn, verts), pair_set(oi, oj)
        assert not oracle - found, f"lost {len(oracle - found)}/{len(oracle)}"
        assert found == oracle
        assert len(oracle) < 4096 * 0.75, len(oracle)

    def test_budget_headroom_at_every_level(self, full):
        verts, faces, segm, parents = full
        fn = make_collision_fn(torch.as_tensor(faces), segm=segm,
                               parents=parents)
        counts = fn.saturation(torch.as_tensor(verts)[None])
        assert set(counts) == {"superblock", "hit_superblock", "hit", "final",
                               "narrow_tris"}
        for level, (count, budget) in counts.items():
            assert int(count[0]) * 2 <= budget, (
                f"level {level!r}: {int(count[0])} surviving pairs vs budget "
                f"{budget}: less than 2x headroom")

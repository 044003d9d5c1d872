"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked `cuda` and skips on a host without a card.  The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from smplifyx_torch.ops import collision as tc
from smplifyx_torch.ops import gather as tg
from smplifyx_torch.models import vposer as tv
from smplifyx_torch.ops import lbs as tlbs
from smplifyx_torch.utils.device import full_f32_matmuls

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(B, V, J, dev, seed, nnz=None):
    """W with `nnz` nonzero weights per row (all J when None), A, v_posed."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    W = torch.rand(V, J, device=dev, generator=gen)
    if nnz is not None:
        keep = torch.rand(V, J, device=dev, generator=gen).argsort(1)[:, :nnz]
        W = torch.zeros_like(W).scatter_(1, keep, W.gather(1, keep))
    W = W / W.sum(-1, keepdim=True)
    A = torch.randn(B, J, 16, device=dev, generator=gen) * 0.3
    A[..., [0, 5, 10, 15]] += 1.0
    v = torch.randn(B, V, 3, device=dev, generator=gen) * 0.5
    return W, A, v


def _full_plan(W):
    """Every column of every row: the kernel then runs the dense loop."""
    V, J = W.shape
    cols = torch.arange(J, dtype=torch.int32, device=W.device).expand(V, J)
    return tlbs.LBSPlan(cols.contiguous(), W)


# The main path's shapes (full mesh over the doubled batch and in
# recover_outputs, the landmark subset), a dense ragged W, V not a tile
# multiple with a single lane, and other widths.
LBS_SHAPES = [(256, 10475, 55, 4), (128, 10475, 55, 4), (256, 224, 55, 4),
              (3, 500, 55, None), (1, 97, 55, 4), (5, 129, 24, None),
              (1, 1, 64, None), (4, 300, 55, 12),
              # SMPL-H and SMPL at full width, and a block of a
              # vertex-sharded SMPL-X (parallel/mesh.py::shard_model)
              (64, 10475, 52, 4), (64, 10475, 24, 4), (256, 5238, 55, 4)]


@pytest.mark.parametrize("B,V,J,nnz", LBS_SHAPES)
def test_lbs_kernel_matches_plain_version(card, B, V, J, nnz):
    W, A, v = _inputs(B, V, J, card, seed=B + V, nnz=nnz)
    plan = tlbs.lbs_plan(W)
    before = tlbs.lbs_apply.launches, tlbs.lbs_plan.builds
    Ak, vk = A.clone().requires_grad_(True), v.clone().requires_grad_(True)
    out = tlbs.lbs_apply(W, Ak, vk, plan)
    gout = torch.randn_like(out)
    (out * gout).sum().backward()
    Ap, vp = A.clone().requires_grad_(True), v.clone().requires_grad_(True)
    ref = tlbs.lbs_reference(W, Ap, vp)
    (ref * gout).sum().backward()
    torch.cuda.synchronize()
    assert (tlbs.lbs_apply.launches, tlbs.lbs_plan.builds) == (before[0] + 1,
                                                               before[1])
    # f32 sums over J in another order
    assert (out - ref).abs().max().item() <= 1e-5
    for got, want in ((Ak.grad, Ap.grad), (vk.grad, vp.grad)):
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-4 * scale
    # given no plan, the wrapper builds one
    assert torch.equal(tlbs.lbs_apply(W, A, v), out.detach())
    assert tlbs.lbs_plan.builds == before[1] + 1


@pytest.mark.parametrize("B,V,J,nnz", [(256, 10475, 55, 4), (128, 10475, 55, 4),
                                       (256, 224, 55, 4), (3, 500, 55, 7),
                                       (1, 97, 55, 4)])
def test_lbs_kernel_skipping_zeros_changes_no_bit(card, B, V, J, nnz):
    """The sparse plan and the full plan (the dense loop over every column)
    give the same bits."""
    W, A, v = _inputs(B, V, J, card, seed=V + 1, nnz=nnz)
    sparse = tlbs.lbs_plan(W)
    assert sparse.cols.shape[1] == nnz
    out = tlbs._kernel_forward(sparse, A, v)
    dense = tlbs._kernel_forward(_full_plan(W), A, v)
    torch.cuda.synchronize()
    assert torch.equal(out, dense)


def test_lbs_kernel_refuses_mixed_devices_and_wide_j(card):
    W, A, v = _inputs(2, 50, 55, card, seed=0)
    with pytest.raises(ValueError):
        tlbs.lbs_apply(W.cpu(), A, v)
    plan = tlbs.lbs_plan(W)
    with pytest.raises(ValueError, match="share one"):
        tlbs.lbs_apply(W, A, v, plan.map(lambda t: t.cpu()))
    with pytest.raises(ValueError, match="plan"):
        tlbs.lbs_apply(W, A, v, tlbs.lbs_plan(W[:49]))
    wide = tlbs._load().lbs_max_joints() + 1
    W, A, v = _inputs(2, 50, wide, card, seed=0, nnz=4)
    with pytest.raises(ValueError, match="J <="):
        tlbs.lbs_apply(W, A, v)


def _rows(B, N, R, C, dev, seed, id_rows=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn(B, N, C, device=dev, generator=gen)
    ids = torch.randint(0, id_rows or N, (B, R), device=dev, generator=gen)
    values = torch.randn(B, R, C, device=dev, generator=gen)
    return table, ids, values


@pytest.mark.parametrize("B,N,R,C", [(256, 10475, 6144, 3), (256, 2048, 8192, 9),
                                     (3, 777, 1001, 3), (3, 129, 333, 9)])
def test_gather_kernel_is_bit_exact(card, B, N, R, C):
    table, ids, _ = _rows(B, N, R, C, card, seed=N)
    before = tg.gather_rows.launches
    out = tg.gather_rows(table, ids)
    ref = tg.gather_reference(table, ids)
    torch.cuda.synchronize()
    assert tg.gather_rows.launches == before + 1
    assert torch.equal(out, ref)


@pytest.mark.parametrize("B,N,R,C,id_rows", [
    (256, 2048, 8192, 9, None), (256, 10475, 6144, 3, None),
    (3, 777, 1001, 3, None), (4, 100, 3000, 3, 5), (4, 64, 3000, 9, 5)])
def test_scatter_kernel_matches_plain_version(card, B, N, R, C, id_rows):
    _, ids, values = _rows(B, N, R, C, card, seed=R, id_rows=id_rows)
    before = tg.scatter_add_rows.launches, tg.scatter_add_rows.join_launches
    out = tg.scatter_add_rows(ids, values, N)
    ref = tg.scatter_add_reference(ids, values, N)
    torch.cuda.synchronize()
    joined = tg._load().scatter_add_rows_tiles(R, C) > 1
    assert (tg.scatter_add_rows.launches,
            tg.scatter_add_rows.join_launches) == (before[0] + 1,
                                                   before[1] + joined)
    # the plain version's index_add_ adds with atomics on the card
    scale = max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("B,N,R,C,id_rows", [
    (256, 2048, 8192, 9, 250), (3, 777, 1001, 3, None), (4, 100, 3000, 3, 5)])
def test_scatter_kernel_is_deterministic(card, B, N, R, C, id_rows):
    """K3 sums each row's segment in a fixed order: the same bits every
    run, within f32 rounding of the CPU's sequential index_add_."""
    _, ids, values = _rows(B, N, R, C, card, seed=R + 1, id_rows=id_rows)
    first = tg.scatter_add_rows(ids, values, N)
    again = tg.scatter_add_rows(ids, values, N)
    cpu = tg.scatter_add_reference(ids.cpu(), values.cpu(), N)
    assert torch.equal(first, again)
    scale = max(1.0, cpu.abs().max().item())
    assert (first.cpu() - cpu).abs().max().item() <= 1e-5 * scale


def _padding_heavy(B, N, R, C, dev, seed):
    """~95% of each lane's ids on row 0, as the pair list's padding slots
    put them at level 2."""
    _, ids, values = _rows(B, N, R, C, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    pad = torch.rand(B, R, device=dev, generator=gen) < 0.95
    return torch.where(pad, 0, ids), values


@pytest.mark.parametrize("B,N,R,C,kind", [
    (256, 2048, 8192, 9, "padding"), (4, 300, 5000, 3, "padding"),
    (3, 777, 1001, 3, "uniform"),       # R not a multiple of the 1,024 tile
    (3, 300, 1001, 5, "uniform"), (2, 64, 2500, 16, "uniform")])
def test_scatter_kernel_is_deterministic_at_every_shape(card, B, N, R, C, kind):
    """K3 with a plan: within 1e-5 per unit of scale of its plain version,
    bit-equal over two launches and to a launch that builds its own plan."""
    if kind == "padding":
        ids, values = _padding_heavy(B, N, R, C, card, seed=R)
    else:
        _, ids, values = _rows(B, N, R, C, card, seed=R)
    plan = tg.row_plan(ids)
    first = tg.scatter_add_rows(plan, values, N)
    again = tg.scatter_add_rows(plan, values, N)
    unplanned = tg.scatter_add_rows(ids, values, N)
    ref = tg.scatter_add_reference(ids, values, N)
    torch.cuda.synchronize()
    assert torch.equal(first, again) and torch.equal(first, unplanned)
    scale = max(1.0, ref.abs().max().item())
    assert (first - ref).abs().max().item() <= 1e-5 * scale


def test_scatter_kernel_propagates_nan_and_drops_out_of_range_ids(card):
    _, ids, values = _rows(2, 50, 700, 9, card, seed=3)
    ids[0, 5] = -1
    ids[1, 7] = 50
    values[0, 9, 4] = float("nan")
    out = tg.scatter_add_rows(ids, values, 50)
    keep = (ids >= 0) & (ids < 50)
    ref = tg.scatter_add_reference(torch.where(keep, ids, 0),
                                   values * keep[..., None], 50)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert int(torch.isnan(out).sum()) == 1
    ok = ~torch.isnan(ref)
    assert (out[ok] - ref[ok]).abs().max().item() <= 1e-5 * max(
        1.0, ref[ok].abs().max().item())


@pytest.mark.parametrize("B,N,R,C", [(256, 10475, 6144, 3), (256, 2048, 8192, 9),
                                     (3, 777, 1001, 3), (3, 300, 1001, 5)])
def test_gather_kernel_is_bit_exact_with_int32_ids(card, B, N, R, C):
    table, ids, _ = _rows(B, N, R, C, card, seed=N + 1)
    plan = tg.row_plan(ids)
    ref = tg.gather_reference(table, ids)
    for i in (ids, ids.int(), plan[:, 0]):
        assert torch.equal(tg.gather_rows(table, i), ref)
    bad = plan[:, 0].clone()
    bad[:, 0] = -1
    out = tg.gather_rows(table, bad)
    torch.cuda.synchronize()
    assert bool(torch.isnan(out[:, 0]).all())
    assert torch.equal(out[:, 1:], ref[:, 1:])


def test_gather_kernels_refuse_what_they_do_not_take(card):
    table, ids, values = _rows(2, 50, 40, 3, card, seed=0)
    with pytest.raises(ValueError, match="share one"):
        tg.gather_rows(table, ids.cpu())
    with pytest.raises(TypeError, match="int32 or int64"):
        tg.scatter_add_rows(ids.short(), values, 50)
    wide = torch.zeros(2, 40, 17, device=card)
    with pytest.raises(ValueError, match="at most 16"):
        tg.scatter_add_rows(ids, wide, 50)


def test_collision_broad_phase_equal_on_card_and_cpu(card):
    """The broad phase is comparisons and IEEE arithmetic: on the same
    vertices the card and the CPU give identical pair lists, and the pair
    gather's VJP through K3 matches the plain version."""
    gen = torch.Generator().manual_seed(0)
    V, F = 400, 600
    verts = torch.rand(2, V, 3, generator=gen)
    base = torch.randint(0, V - 3, (F, 1), generator=gen)
    faces = torch.cat([base, base + 1, base + 2], dim=1)
    kw = dict(max_pairs=512, max_tris=256, sigma=0.01)
    cpu = tc.make_collision_fn(faces, **kw)
    gpu = tc.make_collision_fn(faces.to(card), **kw)
    want = cpu.build(verts)
    got = gpu.build(verts.to(card))
    for name, w in want._asdict().items():
        assert torch.equal(getattr(got, name).cpu(), w), name
    vg = verts.to(card).requires_grad_(True)
    vp = verts.to(card).requires_grad_(True)
    args = (got.tri_corners, got.pa, got.pb)
    ta, tb = tc.pair_gather(vg, *args)
    ra, rb = tc.pair_gather_reference(vp, *args)
    assert torch.equal(ta, ra) and torch.equal(tb, rb)
    (ta.sum() + 2 * tb.sum()).backward()
    (ra.sum() + 2 * rb.sum()).backward()
    torch.cuda.synchronize()
    scale = max(1.0, vp.grad.abs().max().item())
    assert (vg.grad - vp.grad).abs().max().item() <= 1e-5 * scale


# K4 (ops/collision.py::level2_hits): the cell's six ignored part pairs;
# meshes: the benchmark's generated full-width surface (F = 20,908, its
# tubes' parts; nb 2614 blocks in 327 superblocks, so the last one is
# padded) and a small random one (F = 600: 75 blocks, 10 superblocks).
IGN6 = ["9,16", "9,17", "6,16", "6,17", "1,2", "12,22"]


@pytest.fixture(scope="module")
def full_surface():
    import numpy as np

    from perfbench.generate import ref, surface

    s = surface(10475, 20908)
    parents = np.maximum(np.asarray(ref.SMPLX_PARENTS), 0)[s["part"]]
    return s["verts"], s["faces"], s["part"], parents


def _level2_case(mesh, surface, B, parts, dev):
    """(collision fn, vertices [B, V, 3]) on `dev`: lanes cycle through the
    rest pose, vertex noise of 3 mm and 1 cm, the body squashed to 30% in
    x (arms into the torso: contacts across parts) and that with 5 mm of
    noise."""
    import numpy as np

    rng = np.random.default_rng(B + 2 * parts)
    if mesh == "full":
        verts, faces, segm, parents = surface
        kw = {}
    else:
        V, F = 400, 600
        verts = rng.random((V, 3)).astype(np.float32) * 0.3
        base = rng.integers(0, V - 3, (F, 1))
        faces = np.concatenate([base, base + 1, base + 2], 1)
        ids = np.asarray([1, 2, 6, 9, 12, 16, 17, 22])
        segm, parents = ids[rng.integers(0, 8, F)], ids[rng.integers(0, 8, F)]
        kw = dict(max_pairs=512, max_tris=256)
    lanes = []
    for b in range(B):
        v = np.array(verts, np.float32)
        kind = b % 5
        if kind >= 3:
            v[:, 0] *= 0.3
        noise = (0.0, 0.003, 0.01, 0.0, 0.005)[kind]
        lanes.append(v + noise * rng.standard_normal(v.shape).astype(np.float32))
    if parts:
        kw.update(segm=segm, parents=parents, ign_part_pairs=IGN6)
    fn = tc.make_collision_fn(torch.as_tensor(np.asarray(faces, np.int64),
                                              device=dev), **kw)
    return fn, torch.as_tensor(np.stack(lanes), device=dev)


def _level2_inputs(fn, verts):
    """The arguments `_step_level2` hands to level2_hits."""
    st = fn.run_steps({"vertices": verts},
                      fn.BUILD_STEPS[:fn.BUILD_STEPS.index("level2")])
    return fn._level2_table(st)[1], st["si_h"], st["sj_h"], st["mb_h"], fn.ign


@pytest.mark.parametrize("parts", [True, False], ids=["parts", "no_parts"])
@pytest.mark.parametrize("B", [1, 7, 256])
@pytest.mark.parametrize("mesh", ["full", "small"])
def test_level2_kernel_is_bit_equal_to_plain_version(card, full_surface, mesh,
                                                     B, parts):
    """K4's hit_bp equals the plain version's on level 1's real outputs,
    and on the same slots with every third row's mask emptied and half the
    other bits dropped (rows the kernel skips, sparse rows)."""
    fn, verts = _level2_case(mesh, full_surface, B, parts, card)
    assert fn.nbp > fn.nb
    tab8, si_h, sj_h, mb_h, ign = _level2_inputs(fn, verts)
    gen = torch.Generator(device=card).manual_seed(B)
    thinned = mb_h & (torch.rand(mb_h.shape, device=card, generator=gen) < 0.5)
    thinned[:, ::3] = False
    for mb in (mb_h, thinned):
        before = tc.level2_hits.launches
        got = tc.level2_hits(tab8, si_h, sj_h, mb, ign)
        want = tc.level2_hits_reference(tab8, si_h, sj_h, mb, ign)
        torch.cuda.synchronize()
        assert tc.level2_hits.launches == before + 1
        assert got.dtype == torch.bool and got.shape == want.shape
        assert torch.equal(got, want)
    print("level2", mesh, B, parts, "live slots",
          int(mb_h.any(-1).sum()), "of", mb_h.shape[0] * mb_h.shape[1],
          "block pairs", int(mb_h.sum()), "hits", int(want.sum()))


@pytest.mark.parametrize("B", [7, 256])
def test_level2_kernel_keeps_the_aux_and_counts_equal(card, full_surface, B,
                                                      monkeypatch):
    """build, build_refresh and saturation through K4 against the same
    calls with the plain level 2 on the card: every CollisionAux field and
    every count equal; one K4 launch per broad phase."""
    fn, verts = _level2_case("full", full_surface, B, True, card)
    before = tc.level2_hits.launches
    aux = fn.build(verts)
    moved = verts + 0.002
    refresh = fn.build_refresh(moved, aux)
    sat = fn.saturation(verts)
    torch.cuda.synchronize()
    assert tc.level2_hits.launches == before + 3
    monkeypatch.setattr(tc, "level2_hits", tc.level2_hits_reference)
    want_aux = fn.build(verts)
    want_refresh = fn.build_refresh(moved, want_aux)
    want_sat = fn.saturation(verts)
    for got, want in ((aux, want_aux), (refresh, want_refresh)):
        for name in tc.CollisionAux._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), name
    for level, (count, budget) in want_sat.items():
        assert torch.equal(sat[level][0], count) and sat[level][1] == budget
    assert int(sat["hit"][0].sum()) > 0


def test_level2_kernel_refuses_what_it_does_not_take(card):
    fn, verts = _level2_case("small", None, 2, True, card)
    tab8, si_h, sj_h, mb_h, ign = _level2_inputs(fn, verts)
    with pytest.raises(ValueError, match="share one"):
        tc.level2_hits(tab8, si_h.cpu(), sj_h, mb_h, ign)
    with pytest.raises(ValueError, match="contiguous"):
        tc.level2_hits(tab8, si_h, sj_h, mb_h.transpose(0, 1).contiguous()
                       .transpose(0, 1), ign)
    with pytest.raises(ValueError, match="at most 16"):
        tc.level2_hits(tab8, si_h, sj_h, mb_h, [(1, 2)] * 17)


def test_vposer_decode_on_card_matches_cpu(card):
    """VPoser's decode and its gradient in z on the card (cuBLAS, TF32 off
    as in the fit) against the same network on the CPU, at random z and at
    z = 0, over the doubled batch of the main path."""
    full_f32_matmuls()
    sd = tv.random_params(0)
    nets = (tv.vposer_from_state_dict(sd, device="cpu"),
            tv.vposer_from_state_dict(sd, device=card))
    gen = torch.Generator().manual_seed(0)
    for z in (torch.randn(256, tv.LATENT_DIM, generator=gen),
              torch.zeros(256, tv.LATENT_DIM)):
        w = torch.randn(256, tv.POSE_DIM, generator=gen)
        res = []
        for net, dev in zip(nets, ("cpu", card)):
            zz = z.detach().to(dev).requires_grad_(True)
            out = net.decode(zz)
            (torch.sin(out) * w.to(dev)).sum().backward()
            res.append((out.detach().cpu(), zz.grad.cpu()))
        (out_cpu, g_cpu), (out_card, g_card) = res
        assert torch.isfinite(out_card).all() and torch.isfinite(g_card).all()
        assert (out_card - out_cpu).abs().max().item() <= 1e-5
        scale = max(1.0, g_cpu.abs().max().item())
        assert (g_card - g_cpu).abs().max().item() <= 1e-4 * scale


def test_procrustes_v2v_on_card_matches_cpu(card):
    """Batched PA-V2V at the main path's width: 256 lanes of V=10475, a
    3x3 SVD per lane on the card, against the same call on the CPU."""
    from smplifyx_torch.evaluation.metrics import procrustes_v2v

    full_f32_matmuls()
    gen = torch.Generator().manual_seed(21)
    gt = torch.randn(256, 10475, 3, generator=gen)
    R = torch.linalg.qr(torch.randn(256, 3, 3, generator=gen))[0]
    R = R * torch.sign(torch.linalg.det(R))[:, None, None]
    pred = 1.3 * (gt + 0.01 * torch.randn(gt.shape, generator=gen)) @ R + 0.5
    cpu = procrustes_v2v(pred, gt)
    got = procrustes_v2v(pred.to(card), gt.to(card))
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.shape == (256, 10475)
    # The alignment comes from f32 sums over 10475 points in another order
    # (relative error ~sqrt(V) eps = 6e-6), so each point moves by that
    # share of its coordinates' size: the bound is per unit of scale.
    scale = pred.abs().max().item()
    assert (got.cpu() - cpu).abs().max().item() <= 1e-5 * scale
    assert (got.mean(-1).cpu() - cpu.mean(-1)).abs().max().item() <= 1e-6 * scale


@pytest.mark.parametrize("name,lr", [("adam", 0.1), ("sgd", 0.02),
                                     ("rmsprop", 0.02)])
def test_first_order_optimizers_on_card_match_cpu(card, name, lr):
    """20 masked first-order steps on a seeded quadratic, 64 lanes, on the
    card and on the CPU: the same optax rules, within 1e-6 per unit of
    scale (f32 products summed in another order)."""
    from smplifyx_torch.fitting.optimizers import (make_optimizer,
                                                   minimize_first_order)

    full_f32_matmuls()
    gen = torch.Generator().manual_seed(5)
    B, D = 64, 12
    A = torch.randn(D, D, generator=gen)
    Q = A @ A.T + 2 * torch.eye(D)
    b = torch.randn(B, D, generator=gen) * 3
    x0 = torch.randn(B, D, generator=gen)
    mask = (torch.arange(D) % 4 != 3).float()
    out = []
    for dev in ("cpu", card):
        Qd, bd = Q.to(dev), b.to(dev)
        res = minimize_first_order(
            lambda x: 0.5 * ((x @ Qd) * x).sum(-1) - (x * bd).sum(-1),
            x0.to(dev), make_optimizer(name, lr), mask=mask.to(dev),
            max_iters=20, ftol=1e-2, gtol=1e-4)
        out.append(res)
    torch.cuda.synchronize()
    cpu, got = out
    assert got.x.device.type == "cuda"
    scale = max(1.0, cpu.x.abs().max().item())
    assert (got.x.cpu() - cpu.x).abs().max().item() <= 1e-6 * scale
    assert torch.equal(got.n_iters.cpu(), cpu.n_iters)
    assert torch.equal(got.x.cpu()[:, mask == 0], x0[:, mask == 0])


def test_native_keypoint_parser_builds_and_reads(tmp_path):
    """The host C++ parser builds on this machine (build/libkeypoints_torch.so)
    and reads a JSON as the Python reader does."""
    import json

    import numpy as np

    from smplifyx_torch.data import keypoints as tkp
    from smplifyx_torch.data import native
    from smplifyx_torch.ops import nvcc

    report = nvcc.build(native.LIBRARY, force=True)
    assert report[native.LIBRARY][0] > 0
    rng = np.random.default_rng(0)
    people = [{k: rng.uniform(0, 800, n * 3).tolist() for k, n in (
        ("pose_keypoints_2d", 25), ("hand_left_keypoints_2d", 21),
        ("hand_right_keypoints_2d", 21), ("face_keypoints_2d", 70))}
        for _ in range(2)]
    path = tmp_path / "a_keypoints.json"
    path.write_text(json.dumps({"people": people}))
    got = native.read_keypoints_native(str(path), True, True, True)
    want = tkp.read_keypoints(str(path), True, True, True).keypoints
    assert got.shape == (2, 135, 3)
    assert np.array_equal(got, want)


def test_vertex_sharded_forward_on_card_matches_unsharded(card):
    """Two vertex blocks on the card (parallel/mesh.py::shard_model): one
    K1 launch per block, vertices and joints within 2e-5 m of the
    unsharded forward, the parameters' gradient too."""
    from smplifyx_torch.models.bodymodel import synthetic_model
    from smplifyx_torch.models.forward import smplx_forward
    from smplifyx_torch.parallel import make_mesh, shard_model
    from smplifyx_torch.problem import ground_truth

    full_f32_matmuls()
    model = synthetic_model(num_verts=10475, seed=0, device=card)
    sharded = shard_model(model, make_mesh(1, 2, devices=[card, card]))[0]
    outs, grads = [], []
    for m in (model, sharded):
        params = ground_truth(8, card)
        params.body_pose.requires_grad_(True)
        before = tlbs.lbs_apply.launches
        out = smplx_forward(m, params)
        if m is sharded:
            assert tlbs.lbs_apply.launches - before == 2
        (out.vertices.square().sum() + out.joints.sum()).backward()
        outs.append(out)
        grads.append(params.body_pose.grad)
    for name in ("vertices", "joints"):
        err = (getattr(outs[0], name) - getattr(outs[1], name)).abs().max()
        assert float(err) <= 2e-5, name
    scale = max(1.0, float(grads[0].abs().max()))
    assert float((grads[0] - grads[1]).abs().max()) / scale <= 1e-4

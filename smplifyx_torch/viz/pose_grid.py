"""VPoser pose-grid renders: decoded body poses tiled into one image.

Counterpart of `smplifyx_tpu/viz/pose_grid.py`.  With `visualize` on and
VPoser driving the body pose, the reference renders the decoded latent's
pose with human_body_prior's `render_smpl_params` into a grid image
(fit_single_frame.py:263-271).  Here each pose is skinned on a
neutral-shape body in one batched forward (kernel K1 on the card), and
each tile is drawn frontally on white by the host rasteriser
(viz/render.py), row-major into one uint8 image.

    python -m smplifyx_torch.viz.pose_grid out.png [--n 9] [--seed 0] \
        [--model_folder DIR] [--vposer_ckpt vposer.pt] [--tile 256] \
        [--platform cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os.path as osp
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from smplifyx_torch.models.forward import BodyParams, smplx_forward
from smplifyx_torch.ops.camera import CameraParams
from smplifyx_torch.utils.device import (
    device_for_platform,
    full_f32_matmuls,
    resolve_device,
)
from smplifyx_torch.viz.render import render_mesh_overlay


def pose_vertices(model, body_poses) -> np.ndarray:
    """Vertices [N, V, 3] of N axis-angle body poses [N, 63] on the model's
    neutral shape: one forward on the model's device, one copy to the
    host."""
    dev = model.lbs_weights.device
    poses = torch.as_tensor(body_poses, dtype=torch.float32,
                            device=dev).reshape(-1, 63)
    full_f32_matmuls()
    params = dataclasses.replace(
        BodyParams.zeros(poses.shape[0], model.num_betas, model.num_expr,
                         model.num_pca, device=dev), body_pose=poses)
    with torch.no_grad():
        out = smplx_forward(model, params, flat_hand_mean=True,
                            use_face_contour=False)
    return out.vertices.cpu().numpy()


def render_vertex_grid(
    vertices: np.ndarray,              # [N, V, 3]
    faces: np.ndarray,                 # [F, 3]
    cols: Optional[int] = None,
    tile: int = 256,
    distance: float = 2.6,
    color: Sequence[float] = (0.65, 0.65, 0.8),
) -> np.ndarray:
    """One frontal tile per mesh; [R*tile, C*tile, 3] uint8, white
    background, row-major."""
    N = vertices.shape[0]
    cols = cols or max(1, int(math.ceil(math.sqrt(N))))
    rows = int(math.ceil(N / cols))
    # A frontal pinhole camera whose focal length makes a ~1.8 m body fill
    # ~85% of the tile at this distance.
    focal = 0.85 * tile * distance / 1.8
    cam = CameraParams(
        rotation=np.eye(3),
        translation=np.asarray([0.0, 0.0, distance], np.float32),
        focal=np.asarray([focal, focal], np.float32),
        center=np.asarray([tile / 2.0, tile / 2.0], np.float32),
    )
    grid = np.full((rows * tile, cols * tile, 3), 255, np.uint8)
    for i in range(N):
        # Flip y (image y grows downward) and centre each body so that
        # every tile frames its body alike.
        v = vertices[i] - vertices[i].mean(axis=0, keepdims=True)
        v = v * np.asarray([1.0, -1.0, 1.0])
        img = render_mesh_overlay(None, v, faces, cam, color=color,
                                  img_size=(tile, tile))
        r, c = divmod(i, cols)
        grid[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = img
    return grid


def render_pose_grid(model, body_poses, cols: Optional[int] = None,
                     tile: int = 256, distance: float = 2.6,
                     color: Sequence[float] = (0.65, 0.65, 0.8)) -> np.ndarray:
    """Render each pose [N, 63] on a neutral-shape body; the tiles of
    `render_vertex_grid`."""
    return render_vertex_grid(pose_vertices(model, body_poses),
                              model.faces.cpu().numpy(), cols=cols,
                              tile=tile, distance=distance, color=color)


def render_latent_grid(model, decode: Callable, latents, **kw) -> np.ndarray:
    """Decode VPoser latents [N, Z] and render the grid (the reference's
    `render_smpl_params(vposer.decode(z))`)."""
    dev = model.lbs_weights.device
    z = torch.as_tensor(np.asarray(latents, np.float32), device=dev)
    with torch.no_grad():
        poses = decode(z)
    return render_pose_grid(model, poses, **kw)


def main(argv: Optional[list] = None) -> None:
    """Sample latent poses from a seed and write their grid as a PNG."""
    from PIL import Image

    from smplifyx_torch.models.bodymodel import load_body_model, synthetic_model
    from smplifyx_torch.models.vposer import (
        load_vposer,
        random_params,
        vposer_from_state_dict,
    )

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("out")
    p.add_argument("--n", type=int, default=9)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model_folder", default=None,
                   help="folder holding smplx/SMPLX_NEUTRAL.npz; synthetic "
                        "geometry if absent")
    p.add_argument("--vposer_ckpt", default=None,
                   help="VPoser checkpoint; random weights if absent")
    p.add_argument("--synthetic_num_verts", type=int, default=512)
    p.add_argument("--tile", type=int, default=256)
    p.add_argument("--platform", default=None,
                   help="gpu (the default) or cpu")
    a = p.parse_args(argv)

    dev = resolve_device(device_for_platform(a.platform))
    if a.model_folder:
        model = load_body_model(
            osp.join(a.model_folder, "smplx", "SMPLX_NEUTRAL.npz"), "smplx",
            device=dev)
    else:
        model = synthetic_model(num_verts=a.synthetic_num_verts, seed=0,
                                device=dev)
    if a.vposer_ckpt:
        vp = load_vposer(a.vposer_ckpt, dev)
    else:
        vp = vposer_from_state_dict(random_params(a.seed), dev)

    rng = np.random.default_rng(a.seed)
    z = rng.normal(0, 1, (a.n, 32)).astype(np.float32)
    grid = render_latent_grid(model, vp.decode, z, tile=a.tile)
    Image.fromarray(grid).save(a.out)
    print(f"wrote {a.out} ({grid.shape[0]}x{grid.shape[1]})")


if __name__ == "__main__":
    main()

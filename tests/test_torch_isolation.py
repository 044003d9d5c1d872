"""The port stands alone: no JAX import anywhere in it, and no silent move
to the CPU when no card is present."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from smplifyx_torch.fitting.pipeline import fit_batch, recover_outputs
from smplifyx_torch.problem import build_problem, slice_config, slice_session
from smplifyx_torch.session import build_fit_session

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "smplifyx_tpu")
SOURCES = sorted((ROOT / "smplifyx_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_by_default(no_card):
    cfg = slice_config(96)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_fit_session(cfg)
    session = build_fit_session(cfg, device="cpu")
    model = session.get_model("neutral")
    _, _, frames, x0, _ = build_problem(2, 96, settings=session.settings,
                                        device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_batch(model, session.settings, session.options, session.schedule,
                  frames, x0, session.decode_body, session.joint_map,
                  edge_idxs=session.edge_idxs)
    with pytest.raises(RuntimeError, match="CUDA"):
        recover_outputs(model, session.settings, x0, session.decode_body,
                        session.joint_map)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_problem(2, 96)
    with pytest.raises(RuntimeError, match="CUDA"):
        slice_session(96)        # the collision-on slice
    assert np.isfinite(x0.numpy()).all()

"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on.

    The default is the card.  Without one, a CUDA request raises: nothing
    moves to the CPU unless the caller asks for it with device="cpu".
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--platform cpu "
            "on the command line, --device cpu for the bench programs) to "
            "run on the CPU"
        )
    return dev


def device_for_platform(platform) -> str:
    """The device a config's `platform` names: None, "gpu" or "cuda" the
    card, "cpu" the CPU.  Any other value ("tpu" included) raises."""
    key = None if platform is None else str(platform).lower()
    if key in (None, "gpu", "cuda"):
        return "cuda"
    if key == "cpu":
        return "cpu"
    raise ValueError(f"platform={platform!r}: the port runs on 'gpu' (or "
                     "'cuda', the default) or 'cpu'")


def full_f32_matmuls() -> None:
    """Keep f32 products and convolutions in full f32 (TF32 off), the
    counterpart of the JAX package's matmul_precision="highest"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

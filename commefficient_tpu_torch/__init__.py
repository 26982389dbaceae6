"""commefficient_tpu_torch — the PyTorch / CUDA port of ``commefficient_tpu``.

The JAX package beside this one is the reference: this package runs the same
federated rounds (same config names, same flat parameter order, same
CountSketch layout and hashes) for ResNet-9 on CIFAR-10 (``train/cv_train``)
and GPT-2 on PersonaChat (``train/gpt2_train``) on an NVIDIA H100, with the
Pallas TPU kernels replaced by hand-written CUDA C++ kernels (``ops/cuda/``),
in their f32 and bf16 forms.

Rules this package keeps (tests/test_torch_isolation.py pins the first):

* it imports ``torch`` and numpy, never ``jax``, ``flax`` or the reference;
* entry points take a ``device`` that defaults to ``"cuda"`` and raise when
  CUDA is absent unless ``"cpu"`` is asked for (``resolve_device``);
* a kernel is chosen by the tensor's device: a CUDA tensor launches the
  kernel, a CPU tensor runs its plain PyTorch version — nothing falls back.
"""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) raises
    when no card is visible; ``"cpu"`` must be asked for explicitly. On the
    card both TF32 switches are turned off: the reference computes in full
    float32, and cuDNN convolutions default to TF32 on Hopper."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; pass "
                "device='cpu' (--device cpu) to run the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    return dev

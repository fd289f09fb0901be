"""Device selection and the precision contract.

The port runs on one CUDA device. CPU execution exists for the tests
and runs only when a caller asks for it by name: nothing falls back to
the CPU because a card is missing.

Precision contract (docs/architecture.md:60-62): f32 matmuls and
convolutions run at full f32 precision, never TF32, and bf16/f16
matmuls accumulate in f32. PyTorch keeps f32 matmuls exact by default
but lets cuDNN convolutions use TF32 and cuBLAS reduce bf16/f16
products in reduced precision, so those switches are set here, when the
package is imported.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device the port runs on: CUDA unless "cpu" is passed.

    Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and PyTorch sees no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev

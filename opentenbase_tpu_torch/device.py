"""Where the port's entry points run: the card unless the caller asks for
the CPU."""

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the first CUDA device, and no CUDA is an error: the
    port never falls back to the CPU unless the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: opentenbase_tpu_torch runs on the GPU "
                "(pass device='cpu' to run the plain PyTorch versions)"
            )
        return torch.device("cuda", 0)
    return torch.device(device)

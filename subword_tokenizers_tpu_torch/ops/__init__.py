"""Device ops of the port: each wrapper launches a hand-written CUDA
kernel for CUDA tensors and runs its plain PyTorch version for CPU
tensors."""


def check_tensor(name, t, dtypes, ndim, device):
    """Raise unless ``t`` has one of ``dtypes``, ``ndim`` dimensions,
    lies on ``device`` and is contiguous."""
    if t.dtype not in dtypes or t.dim() != ndim:
        raise TypeError(f"{name}: expected {ndim}-d {dtypes}, got "
                        f"{t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

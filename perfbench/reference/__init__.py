"""The benchmark's plain reference: float32 PyTorch forward passes that
import nothing of the program, read the raw weight trees the benchmark
made (never what the program derived from them) and set their own TF32
flags only around their own work (:func:`fp32`)."""
import contextlib

import torch


@contextlib.contextmanager
def fp32():
    """Matmuls and cuDNN convolutions in true float32 inside the block,
    the caller's flags restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

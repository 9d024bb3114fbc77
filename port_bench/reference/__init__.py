"""The benchmark's plain reference: plain PyTorch, no code of the program.

`model.py` holds the model's functions, `precision.py` the precision of
its products (float32 for the reference, fp8 for the control), `train.py`
the training steps it follows, `depth.py` the depth frames it recomputes.
"""
import torch


def set_exact() -> None:
    """float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

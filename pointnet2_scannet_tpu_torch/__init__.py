"""pointnet2_scannet_tpu_torch — the PyTorch + CUDA port of pointnet2_scannet_tpu.

The JAX package beside it is the reference: this package mirrors its module
paths and public names, keeps its channels-last layout ((B, N, C) and
(B, M, K, C)) at every public function, and is held against it by tests that
feed both the same numpy inputs. It imports torch and never jax.

The six Pallas kernels of the SSG and MSG serving and training paths are
hand-written CUDA kernels for Hopper here (ops/cuda/, csrc/); every other op
is plain PyTorch.

Float32 matrix products run in full float32: TF32 is switched off for both
matmuls and cuDNN, since it keeps about three decimal digits and the port's
logits are held to the JAX package's at 1e-4.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

"""PyTorch + CUDA port of the srslte_emane_tpu physical layer.

Each module sits at the same relative path as its twin in `srslte_emane_tpu`
and keeps the same public names and conventions: split-complex float32
tensors with a trailing (re, im) axis, int8 bits, positive LLR <=> bit 0.
This package imports torch and never jax.

Float32 matrix products run in full float32: the channel estimator's
interpolation matrices need more than TF32's ~3 decimal digits.  (The GF(2)
products of CRC, Gold sequence and turbo encoder are 0/1-valued and exact
either way.)
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

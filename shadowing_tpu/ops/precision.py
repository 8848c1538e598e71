"""Matmul precision of every float32 contraction whose error can change a
result, named in one place.

On an H100 a float32 ``dot`` at ``Precision.DEFAULT`` or ``Precision.HIGH``
runs in TF32 (a 10-bit mantissa: 3.3e-4 relative error measured on a
1024 x 147 x 1024 product), which is too coarse to rank windows at the k
boundary, so no contraction here is left at the default. Three roles:

* :data:`SELECT` — the XLA contractions that only *select* candidates
  (window norms, combined filters, the Toeplitz cross term, the factored
  responses and the plain factored product). Pass 2 rescores the selected
  blocks exactly and certifies the selection against the pass-1 error it
  observes, so any error class near float32 is safe. ``HIGHEST`` (float32
  products, 5e-7 measured) runs on every backend: XLA's CPU backend does
  not lower ``BF16_BF16_F32_X3`` for every dot shape and has no
  ``TF32_TF32_F32_X3`` at all.
* :data:`KERNEL` — the product inside the factored pass-1 kernel
  (``ops/factored.blockmin_triton``, CUDA only). ``BF16_BF16_F32_X3``
  (hi/lo bf16 splits, three tensor-core products, 5e-6 relative) ran the
  kernel 2.3x faster than ``HIGHEST`` at 64 contexts on an H100 and as fast
  at one; ``TF32_TF32_F32_X3`` was slower than both (PERF.md).
* :data:`EXACT` — the exact rescore of the winners, the direct oracle, the
  scattering statistics and the Hedged-MC regressions: full float32.
"""
from __future__ import annotations

import jax

SELECT = jax.lax.Precision.HIGHEST
KERNEL = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
EXACT = jax.lax.Precision.HIGHEST

"""mmlearn-tpu on PyTorch and CUDA (NVIDIA Hopper).

The port of :mod:`mmlearn_tpu` to PyTorch. It mirrors that package module
for module, so each counterpart sits at the same path; the JAX package stays
the reference every module here is tested against. It imports ``torch`` and
never ``jax`` or ``flax``.

Every Pallas kernel on a ported path is a kernel written by hand for Hopper
(``sm_90a``) here: CUDA C++ under ``csrc/``, built by :mod:`._build` at first
use, or Triton. Beside each kernel sits its plain PyTorch version, which a
wrapper takes only for a tensor that lies on the CPU.

Ported so far: the embedding-serving path (encoders, artifact export, the
embedding index and the HTTP server), forward only.
"""

__version__ = "0.1.0"

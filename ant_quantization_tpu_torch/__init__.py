"""PyTorch/CUDA port of the ANT/OliVe quantized serving engine.

Beside the JAX package ``ant_quantization_tpu`` (the reference), this
package runs the quantized decoder-LM serving path on an NVIDIA Hopper
card. Its module names mirror the reference's, so each piece has an
obvious counterpart. It imports torch and numpy only: never jax, and
nothing of the reference package.

Entry points take a ``device`` that defaults to ``"cuda"`` and raise when
no card is present; ``device="cpu"`` runs the plain PyTorch versions of
the kernels (the tests do this). The hand-written CUDA kernels live in
``csrc/`` and are built on first CUDA use (``_ext.py``).
"""

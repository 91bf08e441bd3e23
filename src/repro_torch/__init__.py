"""PyTorch/CUDA port of the serving stack, one slice at a time.

The JAX package ``repro`` is the reference; every module here mirrors its
counterpart by path (``repro_torch/serve/decode.py`` ↔
``repro/serve/decode.py``). This package imports ``torch`` and numpy only.
"""

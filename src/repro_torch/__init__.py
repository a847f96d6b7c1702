"""PyTorch/CUDA port of the HSA reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
names and never imports it (nor jax).  Slice 1 serves the RetNet family:
W8A8 prefill, MXINT4 decode and chunkwise retention run through the CUDA
kernels in ``kernels/csrc``, built with ``nvcc`` at first use.

Entry point::

    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    engine = InferenceEngine.from_config("retnet-1.3b", EngineSpec())
    result = engine.generate(prompts)          # prompts: int [B, S] on the card
"""

"""pipeinfer_tpu_torch — the PyTorch/CUDA port of pipeinfer_tpu.

The same system (GGUF k-quant models, a draft/target pair, the async
PipeInfer controller with device-corrected chaining) on PyTorch, with the
JAX package's Pallas kernels rewritten by hand in CUDA C++ for Hopper
(``csrc/``). Module names mirror ``pipeinfer_tpu`` so each counterpart is
easy to find; the port imports ``torch`` and never ``jax``, and nothing of
``pipeinfer_tpu`` — the jax-free modules it needs are kept as copies.

Entry points (``models.load_model``, ``runtime.context.InferenceContext``,
``spec.controller.PipeInferController``) run on ``cuda`` unless the caller
passes ``device="cpu"``; on the CPU every kernel wrapper runs its plain
PyTorch version.
"""

__version__ = "0.1.0"

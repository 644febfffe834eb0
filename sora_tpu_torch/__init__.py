"""sora_tpu_torch — the PyTorch/CUDA port of the sora_tpu software radio.

Same layout as ``sora_tpu``, so each module's counterpart is easy to find.
It imports torch and numpy only: nothing of JAX and nothing of
``sora_tpu``, whose numpy tables it keeps its own copies of.  The TPU's
Pallas kernel becomes a hand-written CUDA kernel for Hopper
(``ops/viterbi_cuda.py`` + ``csrc/viterbi.cu``).

Functions that take tensors compute on the tensor's device; entry points
that take host data default to CUDA and raise without it.  The CPU is used
only when the caller asks for it, as the tests do.
"""

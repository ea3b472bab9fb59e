"""whisper_tpu_torch: the PyTorch/CUDA port of whisper_tpu for NVIDIA Hopper.

Offline batched greedy transcription (``pipeline.WhisperPipeline``), the
continuous-batching HTTP server (``serving``, ``python -m
whisper_tpu_torch.serving``) and seek-based long-form transcription with
timestamps and subtitle files (``python -m whisper_tpu_torch.cli
--longform``), with hand-written sm_90a kernels for the fused log10 mel
(``ops.log10_mel``), the W8A8 encoder's int8 GEMM (``ops.int8_gemm``),
encoder self-attention (``ops.flash_attention``) and the decode step's int8
cross-attention and self-attention (``ops.decode_attention``). The kernels
build with nvcc at first use; on CPU tensors every kernel wrapper runs its
plain PyTorch version. Importing the package needs neither a card nor nvcc,
and imports nothing of ``jax`` or of the ``whisper_tpu`` reference package.
"""

__all__ = ["__version__"]
__version__ = "0.1.0"

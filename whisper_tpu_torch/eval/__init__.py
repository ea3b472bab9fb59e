"""Evaluation: the quantization gate (``quant_gate``: KL and top-1 of each
int8 or approximate variant against fp32, teacher-forced, no labels) and the
WER harness (``wer``; ``python -m whisper_tpu_torch.eval``)."""

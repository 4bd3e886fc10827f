"""Streaming transcription: one online session, and many batched onto one
forward (the port's copy of lcasr_tpu/serving)."""
from lcasr_torch.serving.transcriber import OnlineTranscriber  # noqa: F401
from lcasr_torch.serving.server import TranscriptionServer  # noqa: F401

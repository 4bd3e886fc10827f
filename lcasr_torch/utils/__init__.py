"""Small helpers of the port (counterpart of lcasr_tpu/utils)."""

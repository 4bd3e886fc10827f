"""CTC decoding."""

"""Leaf ops: norms, rotary, feed-forward, attention, convolutions."""

"""Long-context streaming inference."""

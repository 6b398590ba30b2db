"""The reference's per-frame evaluation metrics."""

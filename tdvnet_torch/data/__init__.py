"""Data: the padded FrameBatch and synthetic scenes."""

"""The plain float32 reference that decides ``correct`` (imports torch and
numpy only)."""

"""Input pipelines of the port (the dummy pretraining stream so far)."""

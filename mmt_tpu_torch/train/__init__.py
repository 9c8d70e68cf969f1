"""Training: losses, optimizer, state, metrics, the pretraining task and the loop."""

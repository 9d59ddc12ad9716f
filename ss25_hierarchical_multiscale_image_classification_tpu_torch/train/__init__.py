"""Training: train state, artifacts and the SimCLR pretraining loop."""

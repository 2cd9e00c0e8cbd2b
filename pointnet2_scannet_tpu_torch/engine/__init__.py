"""Serving engine of the port: checkpoints, the Predictor, host metrics."""

"""Serving-side training package: checkpoints, evaluation, experiments,
CLI."""

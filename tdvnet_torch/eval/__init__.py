"""Evaluation: 2D depth metrics, whole-scene inference and the harness
plug-in."""

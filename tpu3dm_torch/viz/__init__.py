"""Headless visualization (port of tpu3dm/viz): file exports and the traced RANSAC."""

"""Inputs made from the seed on the device: weights, volumes, the chair."""

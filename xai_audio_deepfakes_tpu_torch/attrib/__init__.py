"""Gradient attribution over the waveform input."""

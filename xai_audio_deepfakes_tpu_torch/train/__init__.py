"""Training loops, checkpoints, artifacts, the detector fit, the closed loop
and the band probe."""

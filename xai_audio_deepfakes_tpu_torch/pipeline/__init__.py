"""The port's end-to-end explanation pipeline."""

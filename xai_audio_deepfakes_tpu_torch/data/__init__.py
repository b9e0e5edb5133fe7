"""Input pipeline."""

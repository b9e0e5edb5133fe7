"""Faithfulness metrics, EER and the evaluation harnesses."""

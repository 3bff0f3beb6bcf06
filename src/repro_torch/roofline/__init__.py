"""Roofline terms of a dry-run cell, counted on fake tensors (``extract``)."""

from repro_torch.roofline.extract import analyze_counts, count_step, roofline_terms  # noqa: F401

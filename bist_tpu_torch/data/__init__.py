"""AVSD data: JSON turns, static-shape batches, feature files, the evaluation loader."""

"""Experiment folders, CSV/JSON statistics, the dataset bootstrap and the
step timer of the runner."""

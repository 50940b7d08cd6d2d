"""PLS fitting (kernel algorithms 1 and 2) and prediction."""

"""Numerical building blocks: statistics, the normal CDF, eigenvectors, Wilcoxon, the deflation kernel."""

"""Core math of the port: groups, regularizers, dual, screening, L-BFGS, solver."""

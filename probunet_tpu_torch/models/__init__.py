"""Probabilistic U-Net modules: EDM layers, U-Net, conv-Gaussian
prior/posterior, Fcomb and their composition."""

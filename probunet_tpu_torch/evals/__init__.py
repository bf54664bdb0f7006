"""Streamed ensemble evaluation: CRPS/MAE/spread, radial PSD, histograms."""

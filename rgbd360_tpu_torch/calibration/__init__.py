"""Calibration helpers of the port."""

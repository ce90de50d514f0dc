"""Covariance-aware drawing of detections (OpenCV)."""

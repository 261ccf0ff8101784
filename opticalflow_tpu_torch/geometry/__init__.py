"""Multi-view geometry: fundamental-matrix estimation and epipolar filtering."""

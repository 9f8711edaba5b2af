"""SE(3) geometry and the geodesic loss (W-last quaternions)."""

"""Flow visualisation without OpenCV: colour wheel, overlays, text,
vanishing point, top view."""

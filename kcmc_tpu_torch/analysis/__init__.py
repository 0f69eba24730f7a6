"""Performance analysis of the port: the roofline model (roofline.py)."""

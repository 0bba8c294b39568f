"""History encoding for the device search."""

"""Engine templates of the port."""

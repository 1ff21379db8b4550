"""Host utilities: the logger, recorder, progress bar, resource monitor and stdin quit."""

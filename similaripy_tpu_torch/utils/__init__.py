"""Host helpers: device selection, progress rendering."""

"""Traffic drivers, one a file, found by the name a cell gives."""

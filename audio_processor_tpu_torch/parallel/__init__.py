"""Scale-out over several devices and processes (port of parallel/)."""

"""Device compute ops: geometry, robust estimation, matching, disparity."""

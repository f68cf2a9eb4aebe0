"""Multi-view geometry of the port."""

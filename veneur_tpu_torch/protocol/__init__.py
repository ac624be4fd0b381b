"""Wire-level helpers: listen-address resolution."""

"""Host-side utilities the port keeps its own copies of."""

"""Host-side data for the port's trainer."""

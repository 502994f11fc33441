"""Host-side utilities: visualisation and a PNG writer and reader."""

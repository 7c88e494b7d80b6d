"""Network modules of the port."""

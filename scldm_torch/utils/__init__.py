"""Weight bridge and initialisation."""

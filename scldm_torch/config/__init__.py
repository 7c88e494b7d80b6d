"""Configs: the YAML loader and the builders of the framework objects."""

"""Configuration records shared by the port's modules."""

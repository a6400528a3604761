"""Pipeline stages of the ported slice."""

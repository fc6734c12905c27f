"""Loss scaling."""

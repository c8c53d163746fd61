"""entropy subpackage."""

"""Adam/AdamW."""

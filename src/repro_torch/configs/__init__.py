"""Model configurations ported so far."""

"""Command-line scripts of the port that measure it on the card."""

"""CPU tests of the benchmark; those marked ``cuda`` run on the card."""

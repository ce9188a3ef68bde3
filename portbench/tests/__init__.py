"""CPU tests of the benchmark; ``-m gpu`` runs the one that needs a card."""

"""One-off measurements of what the card offers, run on a machine with a
CUDA card and ``nvcc``; nothing in the port imports them."""

"""The SPADE model family as torch modules."""

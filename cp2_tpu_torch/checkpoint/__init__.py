"""flax ⇄ torch weight bridge."""

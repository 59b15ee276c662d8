"""Design evaluation metrics."""

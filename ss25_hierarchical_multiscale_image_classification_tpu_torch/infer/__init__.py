"""Full-slide inference."""

"""Weight bridge from the reference parameter trees."""

"""Models (the Satorras EGNN family), parameter import and loading."""

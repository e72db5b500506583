"""One driver a kind of filter, found by a configuration's ``filter`` key."""

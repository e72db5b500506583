"""Host-side helpers (a copy of the reference's ``utils`` the port needs)."""

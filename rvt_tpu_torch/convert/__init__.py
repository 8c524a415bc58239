"""Weight conversion into the port's state_dict."""

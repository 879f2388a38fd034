"""One module per kind of traffic: it sets a cell up, drives its window and
holds what the check compares."""

"""Feature extractors: ContentVec content features and CREPE pitch."""

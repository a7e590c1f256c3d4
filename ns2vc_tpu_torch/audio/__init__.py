"""Audio helpers of the port (the iSTFT pieces of the Vocos head)."""

"""The plain reference that decides ``correct``: torch and numpy only,
nothing of the program under test."""

"""The plain reference of the join and the comparison that decides
``correct``. Plain torch and numpy: nothing here imports the program."""
